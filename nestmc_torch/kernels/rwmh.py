"""Batched random-walk Metropolis block update, and the helpers every MH
block update shares.

Port of :mod:`nestmc.kernels.rwmh`. One call proposes and accepts or
rejects all chains and, for grouped blocks, all conditionally independent
units at once. The sweep runs it for blocks
without a fused step (here the hier_logistic log_tau block); the group
block runs the fused RW step (ops/cuda/mh_accept), whose plain version is
this update given the same noise. A block with a preconditioner
(KernelConfig.precond) always runs this update, its noise shaped by
:func:`apply_precond`.
"""

from __future__ import annotations

import torch

from nestmc_torch.model import Block, ModelSpec
from nestmc_torch.parallel.collectives import unit_draw


def bcast_over_unit_shape(s, block: Block):
    """Reshape a (C, U') scale array to broadcast against the block value:
    grouped (C, U, *unit_shape), scalar (C, *shape); U' is U or 1."""
    nd = len(block.unit_shape)
    if block.units:
        return s.reshape(tuple(s.shape) + (1,) * nd)
    return s.reshape((s.shape[0],) + (1,) * nd)


def as_cu(d, block: Block):
    """Normalise a conditional log-density to (C, U) (U = 1 for scalar
    blocks)."""
    return d if block.units else d[:, None]


def apply_precond(eps, pstd):
    """Shape the proposal noise: elementwise std (diag) or L eps (a full
    Cholesky factor, told by its extra trailing matrix dim)."""
    if pstd is None:
        return eps
    if pstd.ndim == eps.ndim + 1:
        return torch.einsum("...ij,...j->...i", pstd, eps)
    return eps * pstd


def accept_prob(log_alpha):
    """min(1, exp(log_alpha)) with NaN -> 0 (NaN proposals must reject)."""
    a = torch.exp(log_alpha.clamp_max(0.0))
    return torch.where(torch.isnan(log_alpha), torch.zeros_like(a), a)


def select_accepted(accept_cu, prop, value, block: Block):
    """Per-unit where() between proposal and current value."""
    if block.units:
        m = accept_cu.reshape(
            tuple(accept_cu.shape) + (1,) * len(block.unit_shape)
        )
    else:
        m = accept_cu.reshape(
            (accept_cu.shape[0],) + (1,) * len(block.unit_shape)
        )
    return torch.where(m, prop, value)


def rwmh_update(rng, block: Block, model: ModelSpec, position, log_scale,
                data, cache=None, pstd=None):
    """One RW-MH update of ``block`` for all chains (and units).

    log_scale: (C, U') log proposal scales. pstd: None or the
    preconditioner's multiplier (adapt.precond_std). cache: (C, U) carried
    self part of the conditional at the current value
    (ModelSpec.cond_cached), so only the proposal's self part is
    evaluated. Noise: eps = rng.normal,
    then log u = rng.log_uniform, in that order (on a unit axis the model
    names, fills of this rank's block: rng.py; the unit axis is dim 1).
    Returns (new_value, alpha (C, U), new_cache).
    """
    value = position[block.name]
    units = unit_draw(model.unit_axes.get(block.name))
    eps = apply_precond(rng.normal(value.shape, units=units), pstd)
    prop = value + bcast_over_unit_shape(torch.exp(log_scale), block) * eps
    if cache is not None:
        self_fn, rest_fn = model.cond_cached[block.name]
        self_new = as_cu(self_fn(prop, data), block)
        d_new = self_new + as_cu(rest_fn(prop, position, data), block)
        d_old = cache + as_cu(rest_fn(value, position, data), block)
    else:
        d_new = as_cu(
            model.cond_logdensity(block.name, prop, position, data), block
        )
        d_old = as_cu(
            model.cond_logdensity(block.name, value, position, data), block
        )
    log_alpha = d_new - d_old
    logu = rng.log_uniform(log_alpha.shape, units=units)
    accept = logu < log_alpha                      # NaN compares False
    new_value = select_accepted(accept, prop, value, block)
    new_cache = None
    if cache is not None:
        new_cache = torch.where(accept, self_new, cache)
    return new_value, accept_prob(log_alpha), new_cache
