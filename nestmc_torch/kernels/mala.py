"""Batched MALA (Metropolis-adjusted Langevin) block update.

Port of :mod:`nestmc.kernels.mala` without the preconditioner. Proposal
v' = v + (s^2/2) g(v) + s eps with the asymmetric-proposal MH correction.
The gradient comes from the model's closed form (``cond_value_and_grad``)
when it has one for the block, else from torch.autograd through
``cond_logdensity`` (the reference takes one jax.vjp there). The sweep runs
this update for blocks without a fused step (here the hier_logistic
log_tau block); the group block runs the fused MALA step
(ops/cuda/mala_accept), whose plain version is this update with the
cond_cached_grad cache, given the same noise.
"""

from __future__ import annotations

import torch

from nestmc_torch.kernels.rwmh import (
    accept_prob,
    as_cu,
    bcast_over_unit_shape,
    select_accepted,
)
from nestmc_torch.model import Block, ModelSpec


def cond_value_and_grad(model: ModelSpec, name, value, position, data):
    """((C, U) or (C,), value-shaped grad) of the block conditional: the
    model's closed form when it returns one, else one backward pass of
    torch.autograd through cond_logdensity (summed over units, which are
    independent, so the gradient is per unit)."""
    if model.cond_value_and_grad is not None:
        out = model.cond_value_and_grad(name, value, position, data)
        if out is not None:
            return out
    with torch.enable_grad():
        v = value.detach().requires_grad_(True)
        d = model.cond_logdensity(name, v, position, data)
        (g,) = torch.autograd.grad(d.sum(), v)
    return d.detach(), g


def _sq_norm_per_unit(x, block: Block):
    """Sum of squares over per-unit parameter dims -> (C, U)."""
    dims = tuple(range(2 if block.units else 1, x.ndim))
    r = torch.sum(x * x, dim=dims) if dims else x * x
    return r if block.units else r[:, None]


def mala_update(rng, block: Block, model: ModelSpec, position, log_scale,
                data, cache=None):
    """One MALA update of ``block`` for all chains (and units).

    cache: optional {'v': (C, U), 'g': value-shaped} carried (logp, grad)
    of the self part of the conditional (ModelSpec.cond_cached_grad) at
    the current value. Noise: eps = rng.normal, then log u =
    rng.log_uniform. Returns (new_value, alpha (C, U), new_cache).
    """
    value = position[block.name]
    s = bcast_over_unit_shape(torch.exp(log_scale), block)
    s2 = s * s
    if cache is not None:
        self_vag, rest_vag = model.cond_cached_grad[block.name]
        rv_old, rg_old = rest_vag(value, position, data)
        d_old = cache["v"] + as_cu(rv_old, block)
        g_old = cache["g"] + rg_old
    else:
        d_old, g_old = cond_value_and_grad(
            model, block.name, value, position, data
        )
        d_old = as_cu(d_old, block)
    eps = rng.normal(value.shape)
    prop = value + 0.5 * s2 * g_old + s * eps
    if cache is not None:
        sv_new, sg_new = self_vag(prop, data)
        sv_new = as_cu(sv_new, block)
        rv_new, rg_new = rest_vag(prop, position, data)
        d_new = sv_new + as_cu(rv_new, block)
        g_new = sg_new + rg_new
    else:
        d_new, g_new = cond_value_and_grad(
            model, block.name, prop, position, data
        )
        d_new = as_cu(d_new, block)

    # log q(a | b) = -||a - b - (s^2/2) g(b)||^2 / (2 s^2) + const
    fwd = prop - value - 0.5 * s2 * g_old           # = s eps
    rev = value - prop - 0.5 * s2 * g_new
    log_q_fwd = -_sq_norm_per_unit(fwd, block)
    log_q_rev = -_sq_norm_per_unit(rev, block)
    log_alpha = d_new - d_old + (log_q_rev - log_q_fwd) / (
        2.0 * torch.exp(2.0 * log_scale)
    )
    logu = rng.log_uniform(log_alpha.shape)
    accept = logu < log_alpha                       # NaN compares False
    new_value = select_accepted(accept, prop, value, block)
    new_cache = None
    if cache is not None:
        new_cache = {
            "v": torch.where(accept, sv_new, cache["v"]),
            "g": select_accepted(accept, sg_new, cache["g"], block),
        }
    return new_value, accept_prob(log_alpha), new_cache
