"""Batched MALA (Metropolis-adjusted Langevin) block update.

Port of :mod:`nestmc.kernels.mala`. Proposal v' = v + (s^2/2) M g(v) +
s L eps with the asymmetric-proposal MH correction, M = L L^T the mass
matrix of the block's preconditioner (identity without one).
The gradient comes from the model's closed form (``cond_value_and_grad``)
when it has one for the block, else from torch.autograd through
``cond_logdensity`` (the reference takes one jax.vjp there). The sweep runs
this update for blocks without a fused step (here the hier_logistic
log_tau block); the group block runs the fused MALA step
(ops/cuda/mala_accept), whose plain version is this update with the
cond_cached_grad cache, given the same noise. A block with a
preconditioner always runs this update.
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
from nestmc_torch.parallel.collectives import groups_mean, unit_draw


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
    if model.unit_axes.get(name) is None:
        # a replicated block of a group-sharded run: its gradient from
        # every group shard's terms (collectives.groups_sum)
        g = groups_mean(g)
    return d.detach(), g


def _sq_norm_per_unit(x, block: Block):
    """Sum of squares over per-unit parameter dims -> (C, U)."""
    dims = tuple(range(2 if block.units else 1, x.ndim))
    r = torch.sum(x * x, dim=dims) if dims else x * x
    return r if block.units else r[:, None]


def _whiten(r, chol):
    """L^-1 r over the trailing unit dim (batched triangular solve)."""
    return torch.linalg.solve_triangular(chol, r[..., None],
                                         upper=False)[..., 0]


def mala_update(rng, block: Block, model: ModelSpec, position, log_scale,
                data, cache=None, pstd=None):
    """One MALA update of ``block`` for all chains (and units).

    pstd: None, a value-shaped std (diagonal mass matrix M = pstd^2) or a
    per-(chain, unit) lower Cholesky factor L with one extra trailing
    matrix dim (M = L L^T, the Haario covariance); the correction's
    M^-1-weighted norms are ||L^-1 r||^2 by a batched triangular solve.
    cache: optional {'v': (C, U), 'g': value-shaped} carried (logp, grad)
    of the self part of the conditional (ModelSpec.cond_cached_grad) at
    the current value. Noise: eps = rng.normal, then log u =
    rng.log_uniform. Returns (new_value, alpha (C, U), new_cache).
    """
    value = position[block.name]
    s = bcast_over_unit_shape(torch.exp(log_scale), block)
    s2 = s * s
    full = pstd is not None and pstd.ndim == value.ndim + 1
    if full:
        mm = torch.einsum("...ij,...kj->...ik", pstd, pstd)   # L L^T

        def m_apply(g):
            return torch.einsum("...ij,...j->...i", mm, g)

        def shape_noise(e):
            return torch.einsum("...ij,...j->...i", pstd, e)
    else:
        def m_apply(g):
            return g if pstd is None else pstd * pstd * g

        def shape_noise(e):
            return e if pstd is None else pstd * e

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
    units = unit_draw(model.unit_axes.get(block.name))
    eps = rng.normal(value.shape, units=units)
    prop = value + 0.5 * s2 * m_apply(g_old) + s * shape_noise(eps)
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

    # log q(a | b) = -||a - b - (s^2/2) M g(b)||_{M^-1}^2 / (2 s^2) + const
    fwd = prop - value - 0.5 * s2 * m_apply(g_old)  # = s L eps
    rev = value - prop - 0.5 * s2 * m_apply(g_new)
    if full:
        fwd, rev = _whiten(fwd, pstd), _whiten(rev, pstd)
    elif pstd is not None:
        inv_sqrt_m = 1.0 / pstd
        fwd, rev = fwd * inv_sqrt_m, rev * inv_sqrt_m
    log_q_fwd = -_sq_norm_per_unit(fwd, block)
    log_q_rev = -_sq_norm_per_unit(rev, block)
    log_alpha = d_new - d_old + (log_q_rev - log_q_fwd) / (
        2.0 * torch.exp(2.0 * log_scale)
    )
    logu = rng.log_uniform(log_alpha.shape, units=units)
    accept = logu < log_alpha                       # NaN compares False
    new_value = select_accepted(accept, prop, value, block)
    new_cache = None
    if cache is not None:
        new_cache = {
            "v": torch.where(accept, sv_new, cache["v"]),
            "g": select_accepted(accept, sg_new, cache["g"], block),
        }
    return new_value, accept_prob(log_alpha), new_cache
